"""PyTorch/CUDA port of the multimodal hand-pose enhancement framework.

A second package beside the JAX one, held against it module by module.
It imports torch, numpy and scipy only.  Entry points run on the CUDA
device unless the caller passes ``device="cpu"``; on a CUDA tensor every
hand-written kernel launches (or raises), and on a CPU tensor its plain
PyTorch version runs.

Layout mirrors the JAX package: ``ops/`` (geometry and the Hopper
kernels), ``lifting/`` (2D -> 3D engine), ``models/`` (generators,
discriminator, the downstream classifiers, the featurizer towers -- BERT,
CLIP text and vision, ResNet-50 -- with their snapshot reader, and the
weights bridge),
``losses/`` (element losses and the adaptive robust loss), ``data/``
(pickles, windows, standardization, categories, synthetic fixtures, the
text and video featurizers and their tokenizers),
``train/`` (the GAN and classifier trainers, their data, optimizers and
checkpoints), ``infer.py`` (enhancement forward and result pickles) and the
``lift``, ``train_gan``, ``inference``, ``classifier_main`` and
``classifier_mlp_main`` CLIs; ``parallel/`` spreads training, serving and
lifting over the ranks of a ``torch.distributed`` group
(``port.get_mesh``, imported on first use).
"""


def __getattr__(name):
    if name == "get_mesh":
        from multimodal_hand_pose_enhancement_for_sign_language_tpu_torch.parallel.mesh import (
            get_mesh,
        )

        return get_mesh
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
