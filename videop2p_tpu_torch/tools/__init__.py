"""Command-line tools of the port that drive its entry points:
``python -m videop2p_tpu_torch.tools.serve_loadgen`` (the closed-loop load
generator and the fleet's telemetry, correctness and incident planes)."""
