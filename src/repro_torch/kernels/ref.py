"""The plain versions of the kernels under the reference's oracle names.

Counterpart of ``repro/kernels/ref.py``, whose pure-jnp oracles are the
ground truth of its Pallas kernels. In the port the plain PyTorch versions
play that part (each CUDA kernel is held against its plain version, and a
CPU tensor runs it), so this module re-exports them under the reference's
names. Their signatures are the port's: batched over the leading client
rows, keys ``[M, 2]``, where the reference's oracles take one block and
one key.
"""
from repro_torch.kernels.flash_attention import \
    flash_attention_plain as attention_ref
from repro_torch.kernels.rmsnorm import rmsnorm_plain as rmsnorm_ref
from repro_torch.kernels.zo_aircomp import \
    aircomp_reduce_plain as aircomp_reduce_ref
from repro_torch.kernels.zo_axpy import zo_axpy2_plain as axpy2_ref
from repro_torch.kernels.zo_axpy import zo_axpy_plain as axpy_ref
from repro_torch.kernels.zo_axpy import zo_dirnorms_plain as zo_dirnorms_ref
from repro_torch.kernels.zo_axpy import zo_replay_plain as zo_replay_ref
from repro_torch.kernels.zo_axpy import zo_walk_plain as zo_walk_ref

__all__ = ["aircomp_reduce_ref", "attention_ref", "axpy2_ref", "axpy_ref",
           "rmsnorm_ref", "zo_dirnorms_ref", "zo_replay_ref", "zo_walk_ref"]
