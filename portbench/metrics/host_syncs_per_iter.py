"""host_syncs_per_iter [syncs]: the host's synchronisations with the card
(``cudaStreamSynchronize``, ``cudaDeviceSynchronize``,
``cudaEventSynchronize`` and synchronous copies) that fall under the port's
spans in the traced slice's whole iterations, per whole iteration
(program_spans.py)."""

from portbench import program_spans


def read(r):
    p = program_spans.of(r)
    return None if p is None else p.syncs_per_iteration()
