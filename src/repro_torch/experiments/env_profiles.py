"""Paper Tables I & II: continent/urban-rural link profiles and their
consequences through the transport model, per-round expected cost (the
port of ``benchmarks/env_profiles.py``; pure numpy)."""

from repro_torch.experiments.common import emit_csv
from repro_torch.transport import DEFAULT, PROFILES, TUNED_EDGE, classify, client_round


def main(fast: bool = False):
    rows = []
    for name, link in sorted(PROFILES.items()):
        out = client_round(
            DEFAULT, link, update_bytes=300_000, local_train_time=300.0, connected=False,
        )
        tuned = client_round(
            TUNED_EDGE, link, update_bytes=300_000, local_train_time=300.0, connected=False,
        )
        rows.append([
            name, int(link.rtt * 1000), link.loss,
            round(out.p_complete, 3),
            round(out.expected_time, 1) if out.p_complete else "inf",
            round(tuned.p_complete, 3),
            round(tuned.expected_time, 1) if tuned.p_complete else "inf",
            classify(DEFAULT, link),
        ])
    emit_csv(
        "env_profiles: Tables I/II link presets through the transport model",
        ["profile", "rtt_ms", "loss", "default_p", "default_round_s",
         "tuned_p", "tuned_round_s", "region"],
        rows,
    )
    by = {r[0]: r for r in rows}
    # Africa-rural must be strictly harder than global-average
    assert by["africa_rural"][4] == "inf" or by["africa_rural"][4] > by["global_avg"][4]
    return rows


if __name__ == "__main__":
    main()
