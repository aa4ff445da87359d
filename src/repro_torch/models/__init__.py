"""Dense GQA decoder (attention + gated MLP) over the paged KV pool."""
