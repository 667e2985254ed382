"""Host-side utilities: HDF5 and wav I/O, file listing, prefetch."""

from pytorchwavenetvocoder_tpu_torch.utils.hdf5 import (  # noqa: F401
    check_hdf5,
    read_hdf5,
    shape_hdf5,
    write_hdf5,
)
from pytorchwavenetvocoder_tpu_torch.utils.files import find_files, read_txt  # noqa: F401
from pytorchwavenetvocoder_tpu_torch.utils.prefetch import (  # noqa: F401
    BackgroundGenerator,
    background,
)
from pytorchwavenetvocoder_tpu_torch.utils.timing import extend_time  # noqa: F401
from pytorchwavenetvocoder_tpu_torch.utils.wavio import read_wav, write_wav  # noqa: F401
