"""Serving substrate of the port: the shared SLA deadline machinery
(repro_torch.serve.sla)."""
