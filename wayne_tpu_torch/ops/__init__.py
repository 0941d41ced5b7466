"""Device-side compute ops in PyTorch (the JAX package's ``ops``). Importing
them builds no kernel: the readout kernels are built at first launch."""

from wayne_tpu_torch.ops.kepler import (  # noqa: F401
    eccentric_anomaly, true_anomaly, projected_separation,
    orbital_phase_angle,
)
from wayne_tpu_torch.ops.transit import (  # noqa: F401
    claret_intensity, claret_total_flux, transit_depth_curve,
    transit_light_curve, uniform_disk_hidden_frac,
)
from wayne_tpu_torch.ops.psf import (  # noqa: F401
    ierf, pixel_fractions_static, pixel_fractions_moving,
)
from wayne_tpu_torch.ops.dispersion import (  # noqa: F401
    TraceParams, trace_params, wl_to_x, x_to_wl, x_deposit_matrix, flat_plane,
)
