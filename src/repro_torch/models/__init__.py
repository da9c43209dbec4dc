"""The embedding-model zoo in PyTorch; mirrors ``repro.models``.

``config`` (``ModelConfig``, ``ShapeConfig``, ``SHAPES``), ``layers``,
``model`` (dense GQA / MQA decoders; the other families raise
``NotImplementedError`` naming their ROADMAP item), ``embedder``
(``embed_tokens``, ``Embedder``) and ``convert`` (``params_from_jax``).
"""
