from repro_torch.core.ensemble import Ensemble, make_ensemble  # noqa: F401
from repro_torch.core.repex import REMDDriver  # noqa: F401
