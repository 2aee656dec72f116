"""Plain PyTorch references of the benchmark's configurations.

Each module follows the published model (MishaLaskin/vqvae: ``models/`` for
the VQ-VAE, ``pixelcnn/models.py`` for the GatedPixelCNN prior) in plain
``torch`` operations, float32 with TF32 off (``precision.fp32``). They import
nothing of the program under test: the benchmark gives the program and the
reference the same seeded weights and inputs, and the reference works out
again whatever the program derived from them.
"""
