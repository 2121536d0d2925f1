"""The kernel tools of the port: the counterparts of the JAX package's
``tools/`` scripts that decide whether a kernel design goes onto the main
path (``tune_kernels``, ``proto_residual_fuse``, ``proto_attn``,
``proto_attn_bwd``, ``proto_gelu``, ``proto_opt``), time the port's
counterparts per width or per part (``profile_kernels``,
``profile_keep025``, ``profile_train_kernels``, ``profile_eval``,
``profile_train``, ``bench_input``) and gate the port on the card
(``accuracy_gate``, ``tpu_parity``), with the fixtures they share
(``_measure``). Each runs as ``python -m tokenreduction_tpu_torch.tools.
<name>``, on the card unless ``--device cpu`` is given; on the CPU only
the plain versions run and the times are the host's."""
