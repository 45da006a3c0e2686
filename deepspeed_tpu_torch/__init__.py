"""DeepSpeed-TPU ported to PyTorch and CUDA for NVIDIA Hopper.

The counterpart of ``deepspeed_tpu``: the same module paths and names, with
PyTorch in place of JAX and hand-written Hopper kernels in place of the
Pallas ones. It imports neither ``jax`` nor ``deepspeed_tpu``. Entry points
run on the card (``device="cuda"``) unless the caller passes
``device="cpu"``, and raise when CUDA is absent rather than falling back.

Ported so far: the paged serving step (``inference.v2.InferenceEngineV2``
with ``paged=True`` over ``models.TransformerLM.forward_paged``) and its
``paged_decode_attention`` CUDA kernel.
"""

__version__ = "0.1.0"
