"""The port's autoscaler package. Only ``gcp.py``'s provider-independent
part is here: the GCE preemption-notice source the node daemon watches
(runtime/node.py) and the authorized REST transport that data/bigquery.py
reads through. The autoscaler loop, its scheduler and its node providers
(the JAX package's ``ray_tpu/autoscaler/``) wait for a slice of their
own: the TPU slice providers need a GPU counterpart designed first.
"""
