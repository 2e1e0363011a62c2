"""Synthetic per-region solar capacity-factor traces (on-site generation)."""
from .synthetic import (N_REGIONS, SolarParams, make_pv_traces, pv_stats,
                        sample_solar_params)

__all__ = ["N_REGIONS", "SolarParams", "make_pv_traces", "pv_stats",
           "sample_solar_params"]
