"""Host-side instrument and astrophysics models (the JAX package's
``models``): they assemble calibration Tables and Scene inputs."""

from wayne_tpu_torch.models.grism import Grism, G102, G141  # noqa: F401
from wayne_tpu_torch.models.detector import WFC3IRDetector  # noqa: F401
from wayne_tpu_torch.models.stellar import Star  # noqa: F401
from wayne_tpu_torch.models.planet import Planet  # noqa: F401
