"""Host pattern layer (masks, BSR container, static partitioner) and the
block-sparse ``nn.Module`` layers."""
