"""Read classification of the PyTorch port (Phymm bank scoring) and its
(data, model) mesh of ranks on torch.distributed."""
