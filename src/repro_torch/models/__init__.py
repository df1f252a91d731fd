"""The LM stack on PyTorch: port of ``repro.models`` for serving and
training every family (``common``, ``attention``, ``blocks_attn``,
``blocks_moe``, the RWKV6 and RG-LRU halves of ``blocks_rnn``, ``lm``,
``encdec``, ``api``)."""
