"""Entry points of the port's LM zoo and curve service (counterpart of
``repro.launch``): ``python -m repro_torch.launch.train`` and
``python -m repro_torch.launch.serve``, and the device meshes they serve on
(``mesh.py``). The reference's dry-run and roofline tools (``dryrun.py``,
``hlo_analysis.py``, ``roofline.py``) wait for a later slice (ROADMAP
queue 1)."""
