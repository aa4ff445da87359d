"""kv_mib_per_req: mapped pages x page bytes (K and V), summed over the
attention layers after the prefill, per request, meaned over the window's
calls; read from the caches' block tables. Moves peak_mem_gib."""

from perfbench.harness import kv_bytes_per_page


def read(ctx):
    recs = ctx.window.records
    pages = sum(r.pre.mapped_pages() for r in recs)
    rows = sum(len(r.call.lengths) for r in recs)
    return pages * kv_bytes_per_page(ctx.prog) / rows / 2 ** 20
