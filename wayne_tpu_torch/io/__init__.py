"""Host-side I/O: FITS ima-style output (the JAX package's ``io``)."""

from wayne_tpu_torch.io.fits import FitsHDU, read_fits, write_fits  # noqa: F401
from wayne_tpu_torch.io.ima import (  # noqa: F401
    write_ima, read_ima, cr_dq_planes, saturation_dq, static_dq_plane,
    default_primary_header,
    DQ_COSMIC_RAY, DQ_SATURATED, DQ_HOT_PIXEL, DQ_REF_PIXEL,
)
