"""MagCache core: host-side skip schedule, presets, calibration, samplers."""
