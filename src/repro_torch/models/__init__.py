# The models that run on the serving paths beside the kNN index:
#   common.py       MLP and the numpy -> torch parameter carry-over
#   recsys.py       xDeepFM forward and retrieval (K5 retrieval_topk)
#   nn.py           dense, RMSNorm, RoPE and attention (K6 flash_attention)
#   transformer.py  the dense decoder: forward, prefill, decode
#   gnn/            gcn, egnn, nequip, mace and their irreps algebra (no kernel)
