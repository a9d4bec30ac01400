from repro_torch.algorithms.bfs import (bfs, bfs_batched, bfs_incremental,
                                        bfs_reference, gather_batch,
                                        multi_source_state)
from repro_torch.algorithms.pagerank import (pagerank, pagerank_distributed,
                                             pagerank_reference,
                                             personalized_pagerank,
                                             personalized_pagerank_reference)
from repro_torch.algorithms.sssp import (sssp, sssp_batched,
                                         sssp_incremental, sssp_reference)
from repro_torch.algorithms.cc import (cc_incremental, cc_reference,
                                       connected_components, symmetrize)
from repro_torch.algorithms.bc import (bc_exact, bc_exact_sequential,
                                       bc_reference, betweenness_centrality,
                                       betweenness_centrality_batched)
from repro_torch.algorithms.continuous import (CONTINUOUS_FORMS,
                                               ContinuousForm,
                                               continuous_form)

__all__ = [
    "bfs", "bfs_batched", "bfs_incremental", "bfs_reference",
    "gather_batch",
    "multi_source_state", "pagerank", "pagerank_distributed",
    "pagerank_reference",
    "personalized_pagerank", "personalized_pagerank_reference", "sssp",
    "sssp_batched", "sssp_incremental", "sssp_reference",
    "connected_components", "cc_incremental", "cc_reference", "symmetrize", "betweenness_centrality",
    "betweenness_centrality_batched", "bc_exact", "bc_exact_sequential",
    "bc_reference", "CONTINUOUS_FORMS",
    "ContinuousForm", "continuous_form",
]
