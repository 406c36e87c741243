"""Launchers of the port: the paper model's command line (`advisor`),
meshes of virtual positions on one device (`mesh.make_mesh`,
`mesh.make_production_mesh`), the per-cell sharding specs and step
builders (`specs`), the train and serve launchers (`train`, `serve`), and
the multi-pod dry run on meta tensors (`dryrun`, its cost tracer in
`_trace`).
"""
