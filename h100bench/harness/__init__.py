"""The benchmark's general parts: the manifest, the graph generator, the
device trace, the peaks and the comparison that decides ``correct``."""
