"""The language models of every registered arch: layers, attention with KV
caches and cross attention, the MoE FFN, the recurrent mixers (RG-LRU,
mLSTM, sLSTM), and the model (forward, encode, prefill, decode). Mirrors
``repro.models``."""
