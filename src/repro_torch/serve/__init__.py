"""Serving substrate of the port: prefill/decode steps and the
continuous-batching engine (repro_torch.serve.engine), the SLA scheduler
over it (.scheduler) and the shared SLA deadline machinery (.sla)."""
