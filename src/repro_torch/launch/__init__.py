"""Meshes of ``torch.distributed`` ranks."""
