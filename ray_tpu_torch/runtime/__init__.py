"""Process-level runtime: head service (cluster metadata + scheduling),
node manager (worker pool + leases + shared-memory store), core worker
(ownership, task submission/execution). See SURVEY.md sections 1-3 for the
reference architecture this mirrors (GCS / raylet / core_worker)."""
