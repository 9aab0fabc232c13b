"""Decision probes of the port: measurements that decide a design question on
the card, on no serving or training path (``int8_chain``: does a fused int8
resblock tower pay?)."""
