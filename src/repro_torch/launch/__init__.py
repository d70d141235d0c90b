"""Entry points of the port's LM zoo and curve service (counterpart of
``repro.launch``): ``python -m repro_torch.launch.train`` and
``python -m repro_torch.launch.serve``. The reference's production meshes,
dry-run and roofline tools (``mesh.py``, ``dryrun.py``,
``hlo_analysis.py``, ``roofline.py``) wait for ROADMAP queue 1 item 14."""
