"""Models of the port: parameter trees, MIND serving and the LM
transformer's serving half (GQA and MLA attention, MoE layers, prefill and
decode)."""
