"""Mean host milliseconds of featurization per answered request in the
traced serving window: the time of every ``Featurizer.featurize_raw`` call
of the Corrector's featurizer (a wrapper on that instance), summed, over
the requests answered."""


def read(obs):
    if not obs.get("serve") or not obs["requests"]:
        return None
    return obs["featurize_ms"]
