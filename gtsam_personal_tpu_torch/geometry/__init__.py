"""Batched geometry: SO(2)/SE(2)/SO(3)/SE(3), calibrations and projection,
Unit3, Sim(2)/Sim(3), essential and fundamental matrices, planes, lines."""
