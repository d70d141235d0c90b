"""Entry points of the port's LM zoo and curve service (counterpart of
``repro.launch``): ``python -m repro_torch.launch.train`` and
``python -m repro_torch.launch.serve``, and the device meshes they serve on
(``mesh.py``), with the dry run and roofline of the launch plans
(``dryrun.py``, ``hlo_analysis.py``, ``roofline.py``)."""
