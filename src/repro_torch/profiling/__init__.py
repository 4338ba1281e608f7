"""Kernel and step-phase timings on the card, for the calibration fit."""
