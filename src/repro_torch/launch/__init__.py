"""Launchers of the port: the paper model's command line (`advisor`),
meshes of virtual positions on one device (`mesh.make_mesh`,
`mesh.make_production_mesh`), the per-cell sharding specs and step
builders (`specs`), and the train and serve launchers (`train`, `serve`).

Not ported: the reference's multi-pod dry run (`dryrun.py`, with
`core/hlo.py`): ROADMAP.md, 'Modules to port', step 10e.
"""
