"""Command-line tools of the port (``python -m videop2p_tpu_torch.tools.<name>``),
the counterparts of the JAX package's root ``tools/`` with the same flags,
exit codes and output: ``ledger_summary`` and ``obs_diff`` (a run ledger's
tables and the regression gate between two runs), ``edit_report``,
``cost_report``, ``fleet_dash``, ``probe_report`` and ``incident_report``
(self-contained HTML pages), ``trace_view`` (span ledgers joined into
trace trees), ``stream_drive`` (the closed-loop streaming driver, on CUDA
unless ``--device cpu``), ``serve_loadgen`` (the closed-loop load generator
and the fleet's telemetry, correctness and incident planes) and
``mesh_compare`` (the CLIs on several GPUs against one). None imports JAX."""
