"""Window problem and LM solver of the port."""
