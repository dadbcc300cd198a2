from .csv_writer import write_aji_csv
from .fmtfloat import format_double

__all__ = ["write_aji_csv", "format_double"]
