"""Linear-algebra pieces of the port (robust m-estimators)."""
