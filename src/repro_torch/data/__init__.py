"""Data substrate of the port: synthetic SVM datasets and the LIBSVM sparse
format (numpy)."""
from repro_torch.data.synthetic import (make_blobs, make_checker,
                                        make_multiclass, make_two_spirals,
                                        train_test_split)
from repro_torch.data.libsvm_format import (BadRowError, CSRData, IngestStats,
                                            count_libsvm_rows, read_libsvm,
                                            read_libsvm_blocks,
                                            read_libsvm_rows_range,
                                            write_libsvm)

__all__ = ["make_blobs", "make_checker", "make_multiclass", "make_two_spirals",
           "train_test_split", "BadRowError", "CSRData", "IngestStats",
           "count_libsvm_rows", "read_libsvm", "read_libsvm_blocks",
           "read_libsvm_rows_range", "write_libsvm"]
