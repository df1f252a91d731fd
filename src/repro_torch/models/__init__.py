"""The LM stack on PyTorch: port of ``repro.models`` for the ``dense``,
``ssm`` and ``hybrid`` families (``common``, ``attention``,
``blocks_attn``, the RWKV6 and RG-LRU halves of ``blocks_rnn``, ``lm``,
``api``)."""
