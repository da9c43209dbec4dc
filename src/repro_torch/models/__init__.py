"""The embedding-model zoo in PyTorch; mirrors ``repro.models``.

``config`` (``ModelConfig``, ``ShapeConfig``, ``SHAPES``), ``layers``
(RMSNorm, RoPE, flash attention, GQA / MQA, MLA, the SwiGLU MLP), ``moe``,
``ssm`` (Mamba2 / SSD), ``model`` (every family of ``repro_torch.configs``:
``hidden_states``, ``forward``, caches, ``prefill``, ``decode_step``; only
``lm_loss`` raises ``NotImplementedError`` naming its ROADMAP item),
``embedder`` (``embed_tokens``, ``Embedder``) and ``convert``
(``params_from_jax``).
"""
