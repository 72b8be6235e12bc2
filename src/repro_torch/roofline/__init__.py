"""Roofline terms of a step from an op walk on the ``meta`` device."""
