"""ECDC compression: the container, bit packing and whole-file compression."""
