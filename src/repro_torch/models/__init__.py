"""Language models, dense and moe families: ``params`` (ParamDef trees and
the bitwise draw), ``layers`` (norms, RoPE, attention, MLPs), ``moe``
(the routed + shared expert FFN), ``lm`` (the ``LM`` facade: prefill and
decode) and ``registry``."""
