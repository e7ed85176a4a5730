"""Utilities of the port (energy-spectrum binning)."""

from .spectrum import observe_spectrum, spectral_stuff  # noqa: F401
