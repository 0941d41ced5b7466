"""Host-side numeric utilities (the JAX package's ``utils``)."""

from wayne_tpu_torch.utils.spectra import (  # noqa: F401
    rebin_spectrum, interp_to_grid, crop_spectrum, blackbody_flam_um,
)
