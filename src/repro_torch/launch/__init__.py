"""Launchers of the port: the paper model's command line (`advisor`).

The reference's mesh, dry-run, train and serve launchers are ROADMAP.md's
step 10 ("Modules to port").
"""
