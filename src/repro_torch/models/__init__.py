"""Language models, every family of the JAX package: ``params`` (ParamDef
trees, the bitwise draw, abstract trees), ``layers`` (norms, RoPE,
attention, MLPs), ``moe`` (the routed + shared expert FFN), ``mla``,
``recurrent`` (RG-LRU, mLSTM, sLSTM), ``shardctx`` (activation
placements), ``lm`` (the ``LM`` facade: forward, loss and its gradient,
prefill and decode), ``lm_engine`` (RE-SGLD) and ``registry``."""
