"""The embedding-model zoo in PyTorch; mirrors ``repro.models``.

``config`` (``ModelConfig``, ``ShapeConfig``, ``SHAPES``), ``layers``
(RMSNorm, RoPE, flash attention, GQA / MQA, MLA, the SwiGLU MLP), ``moe``,
``ssm`` (Mamba2 / SSD), ``model`` (every family of ``repro_torch.configs``:
``hidden_states``, ``forward``, caches, ``prefill``, ``decode_step``,
``lm_loss``, ``params_shape``; each runs on one device or on local shards
under ``distributed.act_sharding``'s mesh policy), ``embedder``
(``embed_tokens``, ``Embedder``) and ``convert`` (``params_from_jax``).
"""
