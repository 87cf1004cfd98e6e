"""Multi-device execution of the port — counterpart of synapta_tpu/parallel.

  - mesh.py    the data mesh of the inference path (one process, N device
               shards), the ("data", "model") rank mesh of the training
               path (one process per device, torch.distributed), and the
               dp x tp training step
  - launch.py  start N ranks of one program on this host and collect their
               results
  - dryrun.py  ``python -m synapta_tpu_torch.parallel.dryrun N``
"""
