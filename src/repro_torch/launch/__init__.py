"""Launchers of the port: the paper model's command line (`advisor`),
meshes of virtual shards on one device (`mesh.make_mesh`), and the train
and serve launchers (`train`, `serve`) on one device.

Not ported: the reference's per-cell sharding specs (`specs.py`), its
256-chip production mesh (`mesh.make_production_mesh`) and the multi-pod
dry run (`dryrun.py`): ROADMAP.md, 'Modules to port', steps 10c-10e.
"""
