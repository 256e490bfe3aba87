"""The reference's socket wire protocol, as the serving frontend speaks it.

``wire`` (the newline-framed codecs and the total ``classify``) and
``netutil`` (``close_server_best_effort``) are the port's own copies of
``tpu_gossip/compat/``'s namesakes; the rest of that package (the socket
peer and seed, ROADMAP item 13) is not ported yet.
"""
