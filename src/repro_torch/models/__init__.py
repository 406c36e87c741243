"""Model zoo of the port: layers, blocks and the causal LM as nn.Modules
(counterpart of repro/models). Ported: attention ("attn", "swa") and
SwiGLU blocks, and the Mamba-2 SSD block ("ssd"); the RG-LRU and MoE
blocks come with step 9, after the kernel redesign work."""
