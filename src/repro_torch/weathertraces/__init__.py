"""Synthetic per-region wet-bulb temperature traces (weather for cooling)."""
from .synthetic import (ClimateParams, N_REGIONS, make_weather_traces,
                        sample_climate_params, weather_stats)

__all__ = ["ClimateParams", "N_REGIONS", "make_weather_traces",
           "sample_climate_params", "weather_stats"]
