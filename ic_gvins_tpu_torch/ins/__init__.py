"""INS mechanization and preintegration of the port."""
