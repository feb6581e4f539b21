"""Serving: the mapping server, its wire, the batcher of CT window solves,
the uplink payloads and the client stubs (counterpart of
hectorgrapher_tpu/cloud/)."""
