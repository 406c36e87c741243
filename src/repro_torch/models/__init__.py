"""Model zoo of the port: layers, blocks and the causal LM as nn.Modules
(counterpart of repro/models). Ported so far: attention ("attn", "swa")
and SwiGLU blocks; the SSM, RG-LRU and MoE blocks come with step 9."""
