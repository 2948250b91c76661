# The system's core, PyTorch port:
#   bngraph.py    Algorithm 1 (BN-Graph, host symbolic phase)
#   reference.py  Algorithms 2/3 host oracles
#   construct.py  device-resident level-synchronous construction sweeps
#   index.py      host KNNIndex view (Definition 4.1, O(k) query)
#   updates.py    Algorithms 4/5 scalar host oracle
#   engine.py     device-resident batched QueryEngine (serving surface)
# Public entry point: the `repro_torch.knn` facade.
