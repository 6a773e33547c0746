"""Data substrate of the port: synthetic SVM datasets, the LIBSVM sparse
format and the synthetic token stream of LM training (numpy)."""
from repro_torch.data.synthetic import (make_blobs, make_checker,
                                        make_multiclass, make_two_spirals,
                                        train_test_split)
from repro_torch.data.libsvm_format import (BadRowError, CSRData, IngestStats,
                                            count_libsvm_rows, read_libsvm,
                                            read_libsvm_blocks,
                                            read_libsvm_rows_range,
                                            write_libsvm)
from repro_torch.data.lm_data import TokenStream, synthetic_token_batches

__all__ = ["make_blobs", "make_checker", "make_multiclass", "make_two_spirals",
           "train_test_split", "BadRowError", "CSRData", "IngestStats",
           "count_libsvm_rows", "read_libsvm", "read_libsvm_blocks",
           "read_libsvm_rows_range", "write_libsvm", "TokenStream",
           "synthetic_token_batches"]
