"""The ported layers over a leading device axis: LeNet, and the LM blocks
(norms, embeddings, RoPE, GQA attention, the Mamba-2 SSD block)."""
