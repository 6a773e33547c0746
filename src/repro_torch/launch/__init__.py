"""Entry points of the port: ``train_svm``, the paper's end-to-end driver."""
