"""Model zoo of the port: layers, blocks and the causal LM as nn.Modules
(counterpart of repro/models): attention ("attn", "swa"), the Mamba-2 SSD
block ("ssd") and the Griffin RG-LRU block ("rglru"), with SwiGLU or
routed mixture-of-experts feed-forwards."""
