from montreal_forced_aligner_tpu_torch.graph.compiler import (
    AlignmentGraphCompiler,
    CompiledGraph,
    batch_graphs,
)

__all__ = ["AlignmentGraphCompiler", "CompiledGraph", "batch_graphs"]
