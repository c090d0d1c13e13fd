"""Language models, dense family: ``params`` (ParamDef trees and the
bitwise draw), ``layers`` (norms, RoPE, attention, MLPs), ``lm`` (the
``LM`` facade: prefill and decode) and ``registry``."""
