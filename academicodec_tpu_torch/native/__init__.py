"""Host-side native code of the port (C++, bound with ctypes, built at first use)."""
