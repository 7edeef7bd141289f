"""Fuzz harnesses over the port's wire codec and datagram-stream parser
(``fuzz_messages``, ``fuzz_dstream``), counterparts of the reference's
``fuzz/``.  Each runs standalone as a module and prints one JSON line."""
