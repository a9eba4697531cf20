"""Factor library of the port."""
