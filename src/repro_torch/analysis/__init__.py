"""Analytic FLOPs and traffic, the FLOP counter over the plain versions, and the calibration fit."""
