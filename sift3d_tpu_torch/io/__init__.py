from .volume import Volume
from .errors import (FileDoesNotExistError, UnsupportedFileTypeError,
                     WrapperNotCompiledError, UnevenSpacingError,
                     InconsistentAxesError, DuplicateSlicesError)
from .dispatch import im_read, im_write
