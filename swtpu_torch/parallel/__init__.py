"""Cross-device helpers of the port: so far the top-k cut of
``swtpu.parallel.sharded`` (``topk``) that single-device serving uses."""
