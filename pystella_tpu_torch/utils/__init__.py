"""The port's utilities: so far the HDF5 run output."""
