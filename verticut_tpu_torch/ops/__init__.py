"""Device ops of the port: enumeration, chunk descriptors, selection,
scans."""
