"""BigQuery datasource over the REST v2 API.

Reference surface: python/ray/data read_bigquery (the reference's
datasource wraps google-cloud-bigquery). This implementation speaks
the jobs.query REST endpoint directly through the same authorized
transport the GKE autoscaler provider uses (metadata-server /
GOOGLE_OAUTH_ACCESS_TOKEN bearer tokens, 401-retry), so it needs no
client library — and tests drive it with the provider's
RecordedTransport fixtures (zero-egress CI).

Plan shape: ONE read task that paginates jobs.query →
getQueryResults. (The reference parallelizes via the BigQuery Storage
API's split streams; the REST surface is paging-only, so the read is
one task and downstream ops re-parallelize via repartition.)
"""

from __future__ import annotations

import numpy as np

_BQ = "https://bigquery.googleapis.com/bigquery/v2"
_PAGE_ROWS = 10000


def _convert(value, bq_type: str):
    if value is None:
        return None
    t = bq_type.upper()
    if t in ("INTEGER", "INT64"):
        return int(value)
    if t in ("FLOAT", "FLOAT64", "NUMERIC", "BIGNUMERIC"):
        return float(value)
    if t in ("BOOLEAN", "BOOL"):
        return value in (True, "true", "TRUE", "True")
    return value


class _BigQueryRead:
    def __init__(self, project: str, query: str, transport=None):
        self.project = project
        self.query = query
        self.transport = transport

    def _http(self):
        if self.transport is not None:
            return self.transport
        from ray_tpu_torch.autoscaler.gcp import GcpTransport

        return GcpTransport()

    def __call__(self):
        http = self._http()
        url = f"{_BQ}/projects/{self.project}/queries"
        reply = http.request(
            "POST",
            url,
            {
                "query": self.query,
                "useLegacySql": False,
                "maxResults": _PAGE_ROWS,
            },
        )
        if not reply.get("jobComplete", True):
            raise RuntimeError(
                "bigquery job did not complete within the synchronous "
                f"window: {reply.get('jobReference')}"
            )
        fields = reply.get("schema", {}).get("fields", [])
        names = [f["name"] for f in fields]
        types = [f.get("type", "STRING") for f in fields]
        columns: "dict[str, list]" = {n: [] for n in names}

        def absorb(rows):
            for row in rows:
                for (name, typ, cell) in zip(
                    names, types, row.get("f", [])
                ):
                    columns[name].append(_convert(cell.get("v"), typ))

        absorb(reply.get("rows", []))
        job_id = reply.get("jobReference", {}).get("jobId")
        token = reply.get("pageToken")
        while token:
            page = http.request(
                "GET",
                f"{url}/{job_id}?pageToken={token}"
                f"&maxResults={_PAGE_ROWS}",
            )
            absorb(page.get("rows", []))
            token = page.get("pageToken")
        return {n: np.asarray(v) for n, v in columns.items()}


def bigquery_tasks(
    *,
    project: str,
    query: "str | None" = None,
    dataset: "str | None" = None,
    transport=None,
) -> list:
    if (query is None) == (dataset is None):
        raise ValueError(
            "read_bigquery takes exactly one of query= or dataset="
        )
    if dataset is not None:
        if "." not in dataset:
            raise ValueError(
                "dataset must be 'dataset.table' (got "
                f"{dataset!r})"
            )
        query = f"SELECT * FROM `{project}.{dataset}`"
    return [_BigQueryRead(project, query, transport=transport)]
