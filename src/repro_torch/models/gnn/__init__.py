# The GNN family (the port of ``repro/models/gnn``): message passing by
# gather, transform and ``index_add`` over edge arrays, in plain torch (the
# reference computes it with ``segment_sum`` and ``einsum`` outside any
# Pallas kernel).
#   common.py   scatters, degree, the species gather, the task losses
#   irreps.py   real CG tables, Wigner D (numpy); sh, tensor products (torch)
#   gcn.py, egnn.py, nequip.py, mace.py   the four architectures
