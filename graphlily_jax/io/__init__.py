from .matrix import (CSRMatrix, CSCMatrix, csr2csc, csc2csr, csr_from_coo,
                     load_csr_matrix_from_float_npz, save_csr_matrix_to_float_npz,
                     csr_matrix_convert_from_float)
from .formatter import (util_round_csr_matrix_dim,
                        util_normalize_csr_matrix_by_outdegree,
                        util_reorder_rows_ascending_nnz, permute_rows,
                        add_self_edges_for_sssp)
from .generate import (uniform_csr, dense_csr, conflict_csr, rmat_csr,
                       iccad_standin, ICCAD_GRAPHS)
