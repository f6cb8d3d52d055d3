"""Host C components of the data path, loaded through ctypes
(``howtotrainyourmamlpytorch_tpu/native/``). A source is compiled on first
use with the system C compiler into the package's git-ignored ``_build/``;
without a compiler every consumer takes its NumPy path, which gives the
same bits.
"""

from .build import load_native_library

__all__ = ["load_native_library"]
