"""Gate-level multiplier models (numpy): netlist, LUT analysis, library."""
