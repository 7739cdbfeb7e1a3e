"""Framework-neutral helpers of the port (NumPy only): the image codecs,
the I/O front end and synthetic scenes."""

from .png import read_png, write_png  # noqa: F401
