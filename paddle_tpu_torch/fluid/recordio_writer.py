"""fluid.recordio_writer (reference: python/paddle/fluid/recordio_writer.py):
the record-file writers of ``paddle_tpu_torch.reader.recordio``."""
from ..reader.recordio import (    # noqa: F401
    convert_reader_to_recordio_file, convert_reader_to_recordio_files)

__all__ = ["convert_reader_to_recordio_file",
           "convert_reader_to_recordio_files"]
