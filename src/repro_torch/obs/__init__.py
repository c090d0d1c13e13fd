"""repro_torch.obs: observability for REMD runs, the port of the JAX
package's ``repro.obs``.

:class:`Telemetry` (configuration and host accumulator) rides the
driver's chunks; :class:`RunReport` is the structured summary every
driver path leaves in ``driver.last_report``.  Telemetry off
(``telemetry=None``) dispatches exactly the operations of an
uninstrumented driver; telemetry on leaves the trajectory bitwise
unchanged.
"""
from repro_torch.obs.report import (REPORT_VERSION, RunReport, build_report,
                                    validate_report)
from repro_torch.obs.telemetry import (PHASES, Telemetry,
                                       accumulate_occupancy,
                                       make_phase_probes, round_trip_fold,
                                       sample_phases)

__all__ = [
    "PHASES", "REPORT_VERSION", "RunReport", "Telemetry",
    "accumulate_occupancy", "build_report", "make_phase_probes",
    "round_trip_fold", "sample_phases", "validate_report",
]
