"""ray_tpu_torch.util: state API, metrics, actor pool, queue, and friends
(reference: python/ray/util/)."""
