"""The LM stack on PyTorch: port of ``repro.models`` for the ``dense``
and ``ssm`` families (``common``, ``attention``, ``blocks_attn``, the
RWKV6 half of ``blocks_rnn``, ``lm``, ``api``)."""
