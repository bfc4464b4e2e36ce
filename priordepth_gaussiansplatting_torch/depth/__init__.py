"""Monocular metric-depth inference (counterpart of the JAX package's
``depth/``): the metric-bins models as ``nn.Module``s, the importer of
torch ViT and ZoeDepth checkpoints, layered configs, border handling and
TTA inference that writes the splatting trainer's 16-bit inverse-depth
priors."""
