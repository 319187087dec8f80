"""PyTorch/CUDA port of histogan_tpu for NVIDIA Hopper GPUs.

It covers HistoGAN sampling and training (``histogan-torch``),
reHistoGAN recoloring and training (``rehistogan-torch``) and the
histogram-pool CLIs (``histogan-create-hist-{data,sample}-torch``). The
package imports torch and never jax or histogan_tpu; its kernels and the
native BGU solver are built at first use, so importing it compiles
nothing. Import the submodules
directly (``histogan_tpu_torch.train.trainer`` and so on).
"""
