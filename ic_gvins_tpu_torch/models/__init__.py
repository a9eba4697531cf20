"""GNSS/INS replay model of the port."""
