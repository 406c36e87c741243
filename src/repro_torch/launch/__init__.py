"""Launchers of the port: the paper model's command line (`advisor`) and
meshes of virtual shards on one device (`mesh.make_mesh`).

The reference's production mesh, dry-run, train and serve launchers are
ROADMAP.md's step 10 ("Modules to port").
"""
