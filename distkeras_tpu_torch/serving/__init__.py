"""Online serving: scheduler (host logic), engine (device face), sampling."""
