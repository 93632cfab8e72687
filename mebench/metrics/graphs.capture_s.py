"""graphs.capture_s: the host seconds of every CUDA-graph capture and
instantiation of the run (the port's ``graphs.capture`` spans, all graphs
on all cards), which set-up pays: read from what the recorder drained
during set-up."""


def read(rec):
    caps = [d["spans"]["graphs.capture"]["host_s"]
            for d in rec.get("setup_spans", ()) if "graphs.capture" in d["spans"]]
    return sum(caps) if caps else None
