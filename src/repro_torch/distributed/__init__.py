"""The port's collectives over a mesh of ``torch.distributed`` ranks."""
