"""Monte-Carlo ensembles and their sharding over an (mc, exp) mesh of
devices (the JAX package's ``parallel``). Realisations are independent
along 'mc' and exposures within a visit along 'exp', so each mesh position
computes its block with no communication (:mod:`.mesh`)."""

from wayne_tpu_torch.parallel.mesh import make_mesh, shard_scenes  # noqa: F401
from wayne_tpu_torch.parallel.ensemble import (  # noqa: F401
    mc_scenes, simulate_ensemble_spectra, extract_spectra,
)
