"""PyTorch + CUDA port of the kNN road-network index (see ``repro_torch.knn``)."""
