"""Data substrate of the port: synthetic SVM datasets (numpy)."""
from repro_torch.data.synthetic import (make_blobs, make_checker,
                                        make_multiclass, make_two_spirals,
                                        train_test_split)

__all__ = ["make_blobs", "make_checker", "make_multiclass", "make_two_spirals",
           "train_test_split"]
