from .synthetic import BORG, MARCONI, SPECS, SURF, WorkloadSpec, make_workload

__all__ = ["BORG", "MARCONI", "SPECS", "SURF", "WorkloadSpec", "make_workload"]
